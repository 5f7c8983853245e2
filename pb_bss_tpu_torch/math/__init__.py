from . import solve  # noqa: F401
