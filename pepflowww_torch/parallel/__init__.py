"""Data parallelism on ``torch.distributed``: process groups (``dist``) and
the row and generator rules of a data-parallel batch (``dp``)."""
