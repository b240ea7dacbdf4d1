"""Runtime steps of the port (serving for now; training lands later)."""
from .train import make_serve_step

__all__ = ["make_serve_step"]
