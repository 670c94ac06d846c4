"""Parallelism across processes: the port's counterpart of ``stlt_tpu/parallel``.

- :mod:`stlt_tpu_torch.parallel.distributed`: ``torch.distributed`` set up
  from the CLIs' ``--num_processes``, ``--process_id`` and
  ``--coordinator_address`` flags, one device per rank;
- :mod:`stlt_tpu_torch.parallel.mesh`: the (data, model, context) grid of
  ranks, its collectives and the active-mesh registry the attention layers,
  the dropout sites and the train step read.

The ``data`` axis runs (``--num_processes N``: each rank its contiguous
rows of every global batch, the gradients summed over the ranks) and the
``context`` axis runs (``--context_parallel``, the ring of
``ops/ring.py``), alone or both at once (a grid of D rings of C ranks,
each with its ring group and its data group); a ``model`` axis above 1
raises with the ``ROADMAP.md`` item it waits for.
"""
