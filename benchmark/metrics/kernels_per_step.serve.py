"""Device kernels per traced serving tick (copies and fills not
counted)."""


def read(rec):
    if rec is None or not rec.steps or not rec.device:
        return None
    return len(rec.kernels()) / rec.steps
