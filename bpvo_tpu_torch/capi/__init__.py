"""The port's C API (counterpart of ``native/bpvo_vo_capi.{h,cc}`` and
``native/vo_c_example.c``): C sources that embed CPython and drive
``bpvo_tpu_torch.VisualOdometry``, built by ``build.py``."""
