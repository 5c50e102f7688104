"""The port's benchmark harness: the yardstick that later changes to
``vit_research_tpu_torch`` are measured against.

Everything that judges the program lives here and imports none of it:
the manifest and the files it names (:mod:`harness.manifest`), seeded
traffic and weights (:mod:`harness.traffic`, :mod:`harness.weights`),
the operation and byte counts and the card's peaks (:mod:`harness.cost`),
the plain reference (:mod:`harness.reference`), the comparison that
decides ``correct`` (:mod:`harness.compare`) and the reading of the
profiler's trace (:mod:`harness.trace`). The entries under
``harness/entries/`` are the only modules that call the program.
"""
