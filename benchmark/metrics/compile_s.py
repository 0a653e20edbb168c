"""compile_s: host clock around compile_r1cs, ended by a synchronize."""


def read(run):
    spans = run.spans.get("compile")
    return spans[0] if spans else None
