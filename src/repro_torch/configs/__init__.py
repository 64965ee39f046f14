"""Model configurations the port builds: the paper's eval models, the
dense ``smollm-360m``, ``gemma-7b``, ``nemotron-4-15b``, ``starcoder2-3b``,
the MoE ``llama4`` Scout and Maverick, the SSM ``mamba2-2.7b`` and the
hybrid ``jamba-v0.1-52b``."""
