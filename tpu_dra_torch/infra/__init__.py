"""The few framework-free helpers the port's serving tier calls.

Copies of parts of ``tpu_dra/infra/`` (the port imports nothing of the
JAX package): :mod:`.deadline` (the budgets behind the Router's stall
watchdog), :mod:`.trace` (the request spans and the flight recorder),
:mod:`.lockdep` (the single-owner role check), :mod:`.metrics` (the
registry the fabric benches give the Router, the autoscaler and the
replicas) and :mod:`.chaos` (the fault schedules the fault drills
replay).
"""
