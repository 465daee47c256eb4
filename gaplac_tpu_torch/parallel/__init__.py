"""Multi-process runs on torch.distributed: the launch, chain sharding, and
the row-sharded dense and low-rank log densities."""
