"""Each system's test hooks, one module a system (``<system>.py``), found by the configuration's ``system``.

A module holds:

* ``faults()``: ``(owner, method, {fault: replacement})``, the method of the
  port that the system's driver calls each call, and a replacement for each
  of ``unchanged`` (the state returned as it came), ``half`` (half of each
  batch left out), ``altered`` (an answer altered where it is produced) and
  ``late`` (the fault the tests plant once the first pass of the pool is
  through: one that a check of the first pass alone would miss);
* ``CONTROL_FAILS``: the numbers compared that the control must fail;
* ``late_shows(checks)``: asserts what the ``late`` fault must show in the
  run's checks;
* where a cell of the system reads each call: ``altered_read()``, ``(owner,
  method, replacement)`` of the read with an answer altered, and
  ``altered_read_shows(checks)``.
"""
