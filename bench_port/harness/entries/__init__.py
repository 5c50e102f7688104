"""Entry points into the program, one module a kind of call, named by a
workload file's ``entry``. An entry's ``Entry(cfg, traffic, seed,
device)`` does the set-up (weights, inputs, the program's objects, the
warm-up of the cell's own shapes); ``call()`` is one call the window
times; ``end_to_end``, ``run_info``, ``release`` and ``checks`` follow
the window in that order; ``control`` gives the control's readings."""

import time


class Clock:
    """Seconds of each set-up phase since the previous one."""

    def __init__(self):
        self.phases, self._t = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now
