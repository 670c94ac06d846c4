"""Parallelism across processes: the port's counterpart of ``stlt_tpu/parallel``.

- :mod:`stlt_tpu_torch.parallel.distributed`: ``torch.distributed`` set up
  from the CLIs' ``--num_processes``, ``--process_id`` and
  ``--coordinator_address`` flags, one device per rank;
- :mod:`stlt_tpu_torch.parallel.mesh`: the (data, model, context) grid of
  ranks, its process groups and the active-mesh registry the attention
  layers read.

Only the ``context`` axis runs (serving under ``--context_parallel``, the
ring of ``ops/ring.py``); a ``data`` or ``model`` axis above 1 raises with
the ``ROADMAP.md`` item it waits for.
"""
