"""Data surface of the port: DMatrix sources, page store and prefetcher,
transfer ledger, synthetic data."""
