"""The multimodal graph: EncodeWorker -> VisionChat, a soft-token
prefill of image patches before the prompt (counterpart of the root
``examples/multimodal/``). Serve it with ``python -m
dynamo_exp_tpu_torch.sdk.serve
dynamo_exp_tpu_torch.examples.multimodal.multimodal_demo:VisionChat
--start-coordinator``.
"""
