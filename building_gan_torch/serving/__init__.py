from .server import InferenceServer  # noqa: F401
