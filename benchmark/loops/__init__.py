"""The loops a traffic mix names (``"loop"`` in ``traffic/<mix>.json``),
one module each, found by that name (``harness/spec.loop``). Each module
has ``run(cell, seed, seconds, traced, device, t0)``, which returns a
``harness.window.Outcome`` with the end-to-end metrics it measured, and
``control_readings(cell, seed, device)``, which ``control.py`` prints."""
