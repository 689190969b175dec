"""Data-parallel plumbing of the port over ``torch.distributed``.

``collectives`` holds the reductions and gathers that data-parallel GBDT
training runs across the ranks of a process group, each bitwise the same
on every rank. ``distributed`` forms that group from a driver rendezvous
or the environment; ``launch`` is the job's entry point.

``mesh``, ``ring_attention`` and ``moe`` are what the sequence tagger
takes from the reference's model parallelism: the five-axis mesh laid
over a world's ranks (dp and sp over ranks; tp where it carries only
the sequence), dense attention, ring and Ulysses attention with their
rotations and all-to-alls, and the dense-dispatch MoE feed-forward
with each rank's share of its auxiliary loss.
"""
