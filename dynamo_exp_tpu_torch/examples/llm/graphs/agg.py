"""Aggregated serving: Frontend -> Processor -> CudaWorker (round-robin).

Counterpart of ``examples/llm/graphs/agg.py``. Serve:

    python -m dynamo_exp_tpu_torch.sdk.serve \
        dynamo_exp_tpu_torch.examples.llm.graphs.agg:Frontend \
        -f dynamo_exp_tpu_torch/examples/llm/configs/agg.json --start-coordinator
"""

from dynamo_exp_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_exp_tpu_torch.examples.llm.components.processor import Processor
from dynamo_exp_tpu_torch.examples.llm.components.worker import CudaWorker

__all__ = ["Frontend", "Processor", "CudaWorker"]
