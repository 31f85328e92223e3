"""The benchmark's machinery: what a cell names (``spec``), its inputs
(``generate``), what every loop shares (``window``), the control's and the
faults' changes to the reference (``faults``), the trace's reduction
(``trace``), the bounds (``roofline``), the comparisons (``check``) and the
result line (``result``). The loops themselves are ``loops/<loop>.py``."""
