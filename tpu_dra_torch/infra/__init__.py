"""The few framework-free helpers the port's serving tier calls.

Copies of parts of ``tpu_dra/infra/`` (the port imports nothing of the
JAX package): :mod:`.deadline` (the budgets behind the Router's stall
watchdog), :mod:`.trace` (the request spans and the flight recorder)
and :mod:`.lockdep` (the single-owner role check).
"""
