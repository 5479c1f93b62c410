"""Set-up: seconds the port's kernel libraries took to build (nvcc, on a
checkout without them) and load in this run (``ops._build.load_s``; the
libraries load once, during set-up).  None where the program keeps no such
counter: traced runs lay this benchmark over older trees too."""


def read(ctx):
    from multimodalworddiscovery_tpu_torch.ops import _build

    return getattr(_build, "load_s", None)
