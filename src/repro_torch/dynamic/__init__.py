"""Plan maintenance under changing values (the value path of
``repro.dynamic``)."""
from .delta import update_values

__all__ = ["update_values"]
