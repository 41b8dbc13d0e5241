"""Out-of-core data for the port: the dataset store, its quantile sketch and
the synthetic sources the ingest CLI streams from."""
