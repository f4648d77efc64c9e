"""Elastic mesh (counterpart of the JAX package's ``elastic/``): the
topology is a runtime variable, not a config constant.

* ``elastic/reshard.py`` -- reshard-on-resume: rewrite a durable
  checkpoint so ``--resume`` continues on another ``MESH_SHAPE`` (and
  process count), the carry round-tripped through the boundary codec on
  the run's device and redistributed on the host, the manifest stamped
  with a chained reshard provenance record.
* ``elastic/migrate.py`` -- the fleet's migration policy: which health
  signals (worker death, watchdog alerts, stale beacons) move a run,
  and the journaled ``migrating`` -> ``requeued`` transition.
* ``fleet/placement.py`` -- the capacity model the scheduler consults
  so that a migration target is chosen, not guessed.
"""
