"""Codec layer: predictors, Rice math, adaptive block encode/decode, and the
host API (``dctpu_torch.codec.api.compress`` / ``decompress``).

``compress`` and ``decompress`` are also names of this package, as in
``dctpu.codec``. They load on first use: the kernels import
``dctpu_torch.codec.predict``, and ``codec.api`` imports the kernels, so an
import here would be circular.
"""

_API_NAMES = ("compress", "decompress")


def __getattr__(name):
    if name in _API_NAMES:
        from dctpu_torch.codec import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted([*globals(), *_API_NAMES])
