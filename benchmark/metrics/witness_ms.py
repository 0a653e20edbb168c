"""witness_ms: the mean host time of the circuit's witness (the builder's
`CircuitInstance.weights` on a reset circuit) inside a request."""


def read(run):
    spans = run.spans.get("witness")
    return sum(spans) / len(spans) * 1e3 if spans else None
