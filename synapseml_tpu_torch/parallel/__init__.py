"""Data-parallel plumbing of the port over ``torch.distributed``.

``collectives`` holds the reductions and gathers that data-parallel GBDT
training runs across the ranks of a process group, each bitwise the same
on every rank. ``distributed`` forms that group from a driver rendezvous
or the environment; ``launch`` is the job's entry point.
"""
