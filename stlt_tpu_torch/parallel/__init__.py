"""Parallelism across processes: the port's counterpart of ``stlt_tpu/parallel``.

- :mod:`stlt_tpu_torch.parallel.distributed`: ``torch.distributed`` set up
  from the CLIs' ``--num_processes``, ``--process_id`` and
  ``--coordinator_address`` flags, one device per rank;
- :mod:`stlt_tpu_torch.parallel.mesh`: the (data, model, context) grid of
  ranks, its collectives and the active-mesh registry the attention layers,
  the dropout sites and the train step read;
- :mod:`stlt_tpu_torch.parallel.sharding`: JAX's Megatron rules on the
  port's parameter names, and the cut of a model to a rank's shards.

The ``data`` axis runs (``--num_processes N``: each rank its contiguous
rows of every global batch, the gradients summed over the ranks) and the
``context`` axis runs (``--context_parallel``, the ring of
``ops/ring.py``), alone or both at once (a grid of D rings of C ranks,
each with its ring group and its data group). The ``model`` axis
(``--model_parallel M``) serves and trains: each rank holds its shards,
the row-parallel products' partials are summed over its model group and
the column-parallel inputs' gradients too (``mesh.model_sum``,
``mesh.model_copy``); checkpoints are gathered to full tensors
(``sharding.py``). Training takes clips below the fused train tail's gate
and no ring; the rest raises with the ``ROADMAP.md`` item it waits for. A
process may start several ranks (``distributed.run_ranks``).
"""
