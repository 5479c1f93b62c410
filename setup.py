"""Build hooks for the native extension (packer.c).

The C extension is OPTIONAL: if the toolchain is unavailable the build falls
back to a pure-Python wheel and ``native.pack_token_file`` uses its Python
path.  pyproject.toml carries all metadata; this file only adds ext_modules.
"""

from setuptools import Extension, setup
from setuptools.command.build_ext import build_ext


class OptionalBuildExt(build_ext):
    def run(self):
        try:
            super().run()
        except Exception as e:  # pragma: no cover
            print(f"warning: native extension build failed ({e}); "
                  "using pure-Python fallback")

    def build_extension(self, ext):
        try:
            super().build_extension(ext)
        except Exception as e:  # pragma: no cover
            print(f"warning: building {ext.name} failed ({e}); "
                  "using pure-Python fallback")


setup(
    ext_modules=[
        Extension(
            "multimodalworddiscovery_tpu.native._packer",
            sources=["multimodalworddiscovery_tpu/native/packer.c"],
            extra_compile_args=["-O3"],
        ),
        Extension(
            "multimodalworddiscovery_tpu_torch.native._packer",
            sources=["multimodalworddiscovery_tpu_torch/native/packer.c"],
            extra_compile_args=["-O3"],
        ),
    ],
    cmdclass={"build_ext": OptionalBuildExt},
)
