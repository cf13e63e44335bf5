from .router import RoutingServer  # noqa: F401
from .server import InferenceServer  # noqa: F401
