"""The JAX package's four examples (``examples/`` at the repository root) as
entry points of the port, each run as ``python -m repro_torch.examples.<name>``:

* ``quickstart``: the paper's schedules rendered, their bubble rates and
  peak memories, the automatic search on profiled times, and one pipelined
  loss of reduced internlm2 on the device;
* ``serve_pipeline``: a prefill and greedy decode steps of reduced
  internlm2 through four pipeline stages on the device;
* ``straggler_replan``: re-planning the schedule for a straggler and
  moving layers off a uniformly slow stage (host only);
* ``train_100m``: a ~100M-parameter GPT trained through the launcher
  under ZB-H2 with checkpoint and restart.

Each takes the JAX example's constants and prints its lines, ends in
``OK``, and runs on the CUDA card unless ``--device cpu`` asks for the CPU
(``straggler_replan`` runs no device work).
"""
