from . import protocol
from .staged import StagedRegressor, ViewState, state_to_wire, wire_to_peer

__all__ = ["protocol", "StagedRegressor", "ViewState", "state_to_wire", "wire_to_peer"]
