"""Model configurations the port builds: every configuration of the
reference, that is the ten assigned architectures (``base.ARCH_IDS``:
dense, MoE, SSM, hybrid, the ``internvl2-1b`` VLM backbone with its
prefix-embedding stub and the ``whisper-small`` encoder-decoder with its
frame stub), the paper's two eval models (``base.REPRO_IDS``) and the
full-width ``qwen15-moe-a2.7b``."""
