"""crs_setup_s: host clock around device_setup, ended by a synchronize
(in a traced run, with the setup's phase timer on)."""


def read(run):
    spans = run.spans.get("crs_setup")
    return spans[0] if spans else None
