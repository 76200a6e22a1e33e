from .ops import Dispatched, Routing, moe_combine, moe_dispatch, moe_route

__all__ = ["moe_route", "moe_dispatch", "moe_combine", "Routing",
           "Dispatched"]
