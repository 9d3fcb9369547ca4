"""Preemption handling for the training loop.

Counterpart of `video_knet_tpu/utils/preemption.py`: SIGTERM and SIGINT set
a flag that the train loop polls, so the current step finishes, a
checkpoint is written and the process returns for the scheduler to restart
it with `--resume-from`. A second signal exits at once with 128 + signum.
Off the main thread no handler can be installed, and the guard stays
silent (its flag is never set).
"""

from __future__ import annotations

import signal
import sys


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # not the main thread / unsupported signal
                pass

    def _handler(self, signum, frame):
        if self.requested:  # second signal: exit now
            sys.exit(128 + signum)
        print(f"signal {signum}: finishing step, checkpointing, exiting", flush=True)
        self.requested = True

    def restore(self) -> None:
        """Put back the handlers this guard replaced."""
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}
