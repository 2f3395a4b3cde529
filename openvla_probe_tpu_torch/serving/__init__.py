"""The action server and its dynamic micro-batcher (the port's copies of
``openvla_probe_tpu/serving``), over the port's `OpenVLA`."""
