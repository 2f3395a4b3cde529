"""Robot-eval glue (counterpart of ``openvla_probe_tpu/robot``): the action
query over the port's `OpenVLA`, verified speculation across a control loop,
the eval-time crop, the gripper conventions and the seeding. The LIBERO and
Bridge rollouts (``libero_utils.py``, ``bridge_utils.py``) need simulators
that are not installed: ROADMAP Queue 1 item 16."""
