"""The program's own spans of a traced window, read by the per-stage
metrics (`metrics/prove_*_ms.py`, `quotient_device_ms.py`,
`msm_device_ms.py`).

`zksnark_tpu_torch.utils.profiling` records, while the profiler runs, a
tree of spans a prove: a root `prove`; its host stages in turn,
`prove.encode`, `prove.issue`, `prove.wait` and `prove.assemble`; and,
on a CUDA card, the device spans `quotient` and `msm`, the stream's wall
time between CUDA events.  The profiler covers only the window, so the
roots that ended without an exception are the window's completed
proves.  A program without the recorder leaves nothing to read.
"""

from __future__ import annotations

from typing import Optional

ROOT = "prove"


def collect(run) -> None:
    if "program_spans" in run.extra:
        return
    try:
        from zksnark_tpu_torch.utils import profiling
    except ImportError:
        return
    spans = getattr(profiling, "spans", None)
    run.extra["program_spans"] = list(spans()) if spans else []


def mean_ms(run, name: str) -> Optional[float]:
    """The mean of span `name` over the window's proves, in ms: None
    unless the roots are as many as the completed requests and each has
    the span."""
    spans = run.extra.get("program_spans")
    if not spans:
        return None
    roots = {s.id for s in spans
             if s.name == ROOT and s.parent is None and s.ok}
    if not roots or len(roots) != len(run.completed):
        return None
    got = {s.prove: (s.end_ns - s.start_ns) / 1e6 for s in spans
           if s.name == name and s.prove in roots}
    if len(got) != len(roots):
        return None
    return sum(got.values()) / len(got)
