from .echo import EchoEngineCore, EchoEngineFull

__all__ = ["EchoEngineCore", "EchoEngineFull"]
