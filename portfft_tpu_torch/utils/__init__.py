from . import layout  # noqa: F401
