"""Device-idle ms per traced serving tick inside the program's
``host.serve.copy_out`` span: the converted audio's copy to the host.
Nothing without the span."""

from benchmark import stages


def read(rec):
    return stages.idle_ms_in(rec, "host.serve.copy_out")
