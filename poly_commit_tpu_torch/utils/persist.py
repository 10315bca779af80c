"""Key, commitment and proof persistence: the reference's checkpoint analogue.

Counterpart of poly_commit_tpu/utils/persist.py, with the same ``.npz``
skeleton. The reference's "checkpoints" are CanonicalSerialize'd SRS and
key files, with prepared pairing elements rebuilt on load
(kzg10/data_structures.rs:57-112). Here any scheme object built from
tensors, numpy arrays, Python ints, bytes and dataclasses round-trips
through one ``.npz`` file: a tensor is stored as numpy from ``.cpu()`` with
its dtype and loads back onto the device the caller names (cuda unless the
caller asks otherwise); ints, bytes and the structure go into a JSON
skeleton. The file is written uncompressed (``np.savez``; the JAX package
compresses): zlib took 41 s to write a MarlinKZG10 committer key at
degree 2^20 - 1 (135 MB; 202 MB raw, written in 0.26 s) on the H100
machine's host, and the loader reads either. Prepared and derived values are not stored: the owning dataclass
rebuilds them on first use. A dataclass is resolved only from a module of
this package, so a file cannot make the loader import anything else (a file
the JAX package wrote names its own classes and is refused).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any

import numpy as np
import torch

from .. import device as D

_TAG = "__pct__"
_PACKAGE = __name__.split(".")[0]  # "poly_commit_tpu_torch"


def _encode(obj: Any, arrays: list):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            _TAG: "dataclass",
            "cls": f"{type(obj).__module__}:{type(obj).__qualname__}",
            "fields": {
                f.name: _encode(getattr(obj, f.name), arrays)
                for f in dataclasses.fields(obj)
            },
        }
    if isinstance(obj, torch.Tensor):
        arrays.append(obj.detach().cpu().numpy())
        return {_TAG: "tensor", "i": len(arrays) - 1}
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {_TAG: "array", "i": len(arrays) - 1}
    if isinstance(obj, bytes):
        return {_TAG: "bytes", "hex": obj.hex()}
    if isinstance(obj, int) and abs(obj) >= 2**53:
        return {_TAG: "bigint", "hex": hex(obj)}
    if isinstance(obj, tuple):
        return {_TAG: "tuple", "items": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, list):
        return [_encode(x, arrays) for x in obj]
    if isinstance(obj, dict):
        return {
            _TAG: "dict",
            "items": [
                [_encode(k, arrays), _encode(v, arrays)] for k, v in obj.items()
            ],
        }
    return obj  # JSON-native (small int, float, str, bool, None)


def _resolve(name: str):
    """The class a skeleton names, from a module of this package only."""
    mod, _, qual = name.partition(":")
    if mod.split(".")[0] != _PACKAGE or not qual:
        raise ValueError(f"refusing to load class {name!r}: not a {_PACKAGE} class")
    cls = importlib.import_module(mod)
    for part in qual.split("."):
        cls = getattr(cls, part)
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
        raise ValueError(f"{name!r} is not a dataclass")
    return cls


def _decode(node: Any, arrays, device):
    if isinstance(node, list):
        return [_decode(x, arrays, device) for x in node]
    if not isinstance(node, dict):
        return node
    tag = node.get(_TAG)
    if tag == "tensor":
        return torch.from_numpy(arrays[node["i"]]).to(device)
    if tag == "array":
        return arrays[node["i"]]
    if tag == "bytes":
        return bytes.fromhex(node["hex"])
    if tag == "bigint":
        return int(node["hex"], 16)
    if tag == "tuple":
        return tuple(_decode(x, arrays, device) for x in node["items"])
    if tag == "dict":
        return {
            _freeze(_decode(k, arrays, device)): _decode(v, arrays, device)
            for k, v in node["items"]
        }
    if tag == "dataclass":
        cls = _resolve(node["cls"])
        return cls(**{k: _decode(v, arrays, device) for k, v in node["fields"].items()})
    return node


def _freeze(x):
    return tuple(x) if isinstance(x, list) else x


def save(path: str, obj: Any) -> None:
    """Serialize a scheme object (keys, commitments, proofs) to one file."""
    arrays: list = []
    skeleton = json.dumps(_encode(obj, arrays))
    np.savez(
        path,
        skeleton=np.frombuffer(skeleton.encode(), dtype=np.uint8),
        **{f"a{i}": a for i, a in enumerate(arrays)},
    )


def load(path: str, device=None) -> Any:
    """The object ``save`` wrote, its tensors on ``device`` (cuda unless
    the caller asks otherwise)."""
    dev = D.resolve(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        skeleton = json.loads(bytes(z["skeleton"].tobytes()).decode())
        arrays = [z[f"a{i}"] for i in range(len(z.files) - 1)]
    return _decode(skeleton, arrays, dev)
