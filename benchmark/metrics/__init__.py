"""One reader a metric, `<name>.py`, found by the metric's name in
BENCHMARK.json: `read(run)` returns the number, or None where the run
holds nothing to read (and the harness then leaves the metric out);
an optional `collect(run)` measures what it needs on the program's state
after a traced window."""
