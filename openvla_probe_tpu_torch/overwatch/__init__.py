from .overwatch import initialize_overwatch

__all__ = ["initialize_overwatch"]
