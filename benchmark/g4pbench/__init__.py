"""The benchmark harness of ``geneo4petsc_tpu_torch``.

``run.py`` is the entry point.  Everything that belongs to one
configuration, traffic mix or per-layer metric sits in a file of its
own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` — a deployment, with its field generator
  (``reference/fields/<kind>.py``), its plain reference operator
  (``reference/<operator>.py``) and its program (``system``);
* ``systems/<system>.<op>.py`` — the system under test running one op
  kind of a traffic mix (``program.py`` says what it exposes);
* ``traffic/<mix>.json`` — the parameters that ``traffic.py``, the one
  general generator, reads;
* ``metrics/<metric>.py`` — one reader per per-layer metric.
"""
