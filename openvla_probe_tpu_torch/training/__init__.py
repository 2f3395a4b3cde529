"""Training for the port (counterpart of ``openvla_probe_tpu/training``).

``lora`` (streamed LoRA and QLoRA over bf16, int8 and grouped-int4 bases),
``train_state`` (AdamW with decay groups and warmup-cosine, written over
trees of tensors as the JAX package's optax chain), ``train_step`` (the
masked next-token loss, action metrics and the step with trainable masks and
gradient accumulation), ``checkpointing`` (the run-dir and resume contract on
``torch.save``) and ``preemption`` (signal to cooperative exit).
"""
