"""Multi-device training and serving (counterpart of ``sed_tpu/parallel``).

One process per card, started by ``torchrun``: ``distributed.py`` joins
the process group and shards the host's batch stream, ``mesh.py`` builds
device meshes, puts a rank's share of a batch on its device and shards
the larger parameters with FSDP, ``dryrun.py`` runs all of it in gloo
processes on the CPU.  Serving over several devices is one process with
one model replica a device (``serve/engine.SedInferenceEngine(devices=)``).
"""
