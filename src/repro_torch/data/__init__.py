"""Data surface of the port: DMatrix, transfer ledger, synthetic data."""
