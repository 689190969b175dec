"""Data-parallel plumbing of the port over ``torch.distributed``.

``collectives`` holds the reductions and gathers that data-parallel GBDT
training runs across the ranks of a process group, each bitwise the same
on every rank. ``distributed`` forms that group from a driver rendezvous
or the environment; ``launch`` is the job's entry point.

``mesh``, ``ring_attention`` and ``moe`` are what the sequence tagger
takes from the reference's model parallelism, on a world of one rank:
the five-axis mesh description, dense, ring and Ulysses attention
without exchanges, and the dense-dispatch MoE feed-forward.
"""
