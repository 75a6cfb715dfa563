"""repro_torch.pipeline — the async page-streaming subsystem.

Counterpart of `repro.pipeline`:

  `PageStream`       disk -> pinned host -> device engine (threaded prefetch,
                     side-stream copies, per-pass overlap accounting into
                     `TransferStats`);
  `DevicePageCache`  LRU of device-resident pages so repeated passes skip
                     transfers;
  `StreamedPage`     what a pass yields: (index, host page, device tensor).
"""
from repro_torch.pipeline.cache import DevicePageCache
from repro_torch.pipeline.stream import PageStream, StreamedPage

__all__ = ["DevicePageCache", "PageStream", "StreamedPage"]
