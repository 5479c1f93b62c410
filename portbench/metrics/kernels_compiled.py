"""Set-up: kernel libraries nvcc built in this run (``ops._build.compiled``):
0 where the checkout had them all, so it says whether ``kernel_load_s``
holds the build.  None where the program keeps no such counter: traced
runs lay this benchmark over older trees too."""


def read(ctx):
    from multimodalworddiscovery_tpu_torch.ops import _build

    return getattr(_build, "compiled", None)
