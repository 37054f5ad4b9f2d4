"""The ways the benchmark drives the program, one module a way, found by
the ``mode`` that a traffic file names (``harness.mode_of``). A new way (the
program over several processes, through its CLI session, its eval step) is
a new module here and a traffic file that names it; the harness is not
edited. A mode module gives:

* ``WINDOW``: the context the window runs in (``torch.inference_mode``);
* ``BACKWARD``: whether an iteration runs the backward (for ``mfu``);
* ``FIRST``: the pool's batch the window starts at;
* ``NUMBERS``: the numbers ``compare`` returns; a cell's limits name some;
* ``FAULTS``: the faults of ``faults.py`` a program driven so can have;
* ``build(cell, weights, device, argv_extra=()) -> harness.Program`` and
  ``reload(prog, cell, weights)``, the next seed's weights in a built
  program (calibration);
* ``warm_up(cell, prog, pool, weights)``: set-up's calls, every shape the
  window runs; returns what the check reads of them, or None;
* ``dispatch(prog, batch)``: one iteration's call, before its sync;
  ``keep(cell, seed)``: the iterations whose outputs the check reads, and
  ``keep_outputs(out)`` what it keeps of one;
* ``readings(cell, warm, kept)``: the program's side of the check;
  ``calibration_readings(cell, prog, pool, weights, seed)`` the same,
  outside a run;
* ``reference(cell, weights, pool, seed, device)``: the plain reference's
  side, run once the program's state is freed;
* ``compare(cell, readings, ref) -> (values, failed)``: the numbers
  compared and the readings beside them, and how many answers failed.

Optional: ``memory_peak_bytes(prog)`` and ``release(prog)``, for a program
that spans processes of its own.
"""
