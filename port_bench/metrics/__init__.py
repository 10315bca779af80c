"""One reader a metric, found by the metric's name: ``read(ctx)`` returns its value, or None where it finds nothing to read."""
