"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once: set-up, the
measured window, then the check against the plain reference, and prints
one JSON result line.  Everything a cell is made of is found by name:

  * a configuration: ``configs/<config>.json``
  * a traffic mix: ``traffic/<mix>.json``, read by the one generator in
    ``generator.py``
  * a per-layer metric: ``metrics/<metric>.py``, a reader with
    ``read(run) -> float | None``

The yardstick modules (``synth``, ``reference``, ``counts``,
``generator``, ``devtrace``, ``check``) import nothing of ``repro_torch``;
only ``cell.py`` drives the program.
"""
