"""``batchnorm_device_ms.cnn`` (ms): device time a step of the work that
BatchNorm launches, told by the outermost op that launched each kernel
(``tracing.ops_of_kernels``): the forward's ``aten::batch_norm`` and the
autograd nodes of its backward (``*BatchNormBackward*``, or its
``aten::*batch_norm_backward`` where the trace shows no node).  The running
statistics' update, a few small element-wise kernels a module, is not
counted.  Layer: the CNN model's BatchNorm.  Moves ``train_images_per_s``."""

from perfbench import tracing

KEYS = ("batch_norm", "BatchNormBackward")


def _is_batchnorm(root: str) -> bool:
    return any(k in root for k in KEYS)


def read(t):
    if t.get("family") != "resnet" or t.get("phase") != "train":
        return None
    evs = [e for e, _, root in tracing.ops_of_kernels(t["events"])
           if _is_batchnorm(root)]
    if not evs:
        return None
    return tracing.busy_us(evs) / 1e3 / t["steps"]
