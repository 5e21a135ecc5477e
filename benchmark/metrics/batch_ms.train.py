"""Mean host milliseconds of ``CorpusDataset.sample_batch`` over the traced
steps (the ``host.sample_batch`` span around each call).  Its copies to the card
come from pageable host memory, so the span also holds their wait for the
step before."""


def read(rec):
    if rec is None:
        return None
    spans = rec.spans("host.sample_batch")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e3
