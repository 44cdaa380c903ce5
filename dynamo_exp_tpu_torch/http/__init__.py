from .service import HttpService, ModelManager, build_pipeline_engine

__all__ = ["HttpService", "ModelManager", "build_pipeline_engine"]
