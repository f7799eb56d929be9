from .gateway import GatewayOverloaded, ServeGateway
from .client import GatewayClient, serve_scenario_live

__all__ = ["GatewayOverloaded", "ServeGateway", "GatewayClient",
           "serve_scenario_live"]
