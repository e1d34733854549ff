"""One reader a per-layer metric, in a file named after the metric: a
function `read(ctx)` that returns the metric's value, or None where the run
holds nothing for it to read."""
