"""The test suite's file order under ``pytest -n N --dist loadfile``.

``--dist loadfile`` keeps a file's tests on one worker, and pytest-xdist
queues the files by their number of tests, most first.  A file of a few long
tests then starts after most of the others, and the whole run waits for it.
The files in ``LONGEST_FIRST`` go to the front of the queue, in that order, so
the longest files start first; every other file keeps xdist's order.  A new
file whose tests run for minutes on one worker joins the list.
"""

from collections import OrderedDict

import pytest

LONGEST_FIRST = (
    "tests/test_parallel.py",
    "tests/test_msm_kernels.py",
)


class _LongestFirstQueue(OrderedDict):
    """xdist's work queue (file -> tests), with the listed files moved to
    the front as they are queued."""

    def __setitem__(self, scope, work_unit):
        super().__setitem__(scope, work_unit)
        if scope in LONGEST_FIRST:
            for first in reversed(LONGEST_FIRST):
                if first in self:
                    self.move_to_end(first, last=False)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    scheduler = LoadFileScheduling(config, log)
    scheduler.workqueue = _LongestFirstQueue()
    return scheduler
