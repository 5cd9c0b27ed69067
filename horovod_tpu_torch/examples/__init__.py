"""The repo's example entry points on the port — counterparts of the
scripts under ``examples/``, one module each, run as
``python -m horovod_tpu_torch.examples.<name>`` (one process) or under
the launcher as ``python -m horovod_tpu_torch.run -np N -- python -m
horovod_tpu_torch.examples.<name>``.

Each keeps its JAX twin's flags, defaults and the lines its tests read
(``[rank r/n] final ...``, ``resumed from epoch N``, ``finished gradual
learning rate warmup``, ``Img/sec per worker:``, the JSON rows), takes
``--device`` (``cuda`` unless ``--device cpu`` is given; no card raises,
nothing falls back to the CPU) and exposes its step at module level.

Recipes: ``mnist``, ``mnist_advanced``, ``imagenet_resnet50``,
``word2vec``, ``torch_mnist`` and ``torch_synthetic_benchmark`` (the
last two through the eager binding, ``horovod_tpu_torch.torch``).
Measurement harnesses: ``collective_microbench``,
``weak_scaling_benchmark``, ``control_plane_benchmark``,
``int8_convergence`` and ``resnet_bn_experiment``.  Audits of the
ordering the port's docs claim, read from the port's own events:
``overlap_audit`` and ``longctx_audit``.
"""
