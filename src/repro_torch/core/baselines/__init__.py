from .lustre import LustreModel

__all__ = ["LustreModel"]
