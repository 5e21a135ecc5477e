"""Device-idle ms per traced serving tick inside the program's
``host.serve.copy_in`` span: the chunks' conversion and their copy, with
the two masks', into the step's static inputs.  Nothing without the
span."""

from benchmark import stages


def read(rec):
    return stages.idle_ms_in(rec, "host.serve.copy_in")
