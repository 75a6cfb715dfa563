"""Data surface of the port: DMatrix sources, page store and prefetcher,
transfer ledger, synthetic data.

The synthetic generators and sources are re-exported here, as `repro.data`
does; the DMatrix, page-store and ledger names stay in their modules
(`repro_torch.pipeline` imports `repro_torch.data.pages`, and
`repro_torch.data.dmatrix` imports `repro_torch.pipeline`, so this package
must not import `dmatrix` while it initialises).
"""
from repro_torch.data.synthetic import (
    ArraySource,
    SyntheticSource,
    make_classification,
    make_higgs_like,
    make_regression,
)

__all__ = [
    "SyntheticSource",
    "ArraySource",
    "make_classification",
    "make_higgs_like",
    "make_regression",
]
