"""Parallelism on ``torch.distributed``: process groups and the (data,
model) grid (``dist``), the row and generator rules of a data-parallel
batch (``dp``), fully sharded training state (``fsdp``) and pair-row tensor
parallelism (``tp``)."""
