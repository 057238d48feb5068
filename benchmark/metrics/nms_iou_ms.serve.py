"""Device ms per request of the NMS's rotated IoU, threshold and label mask (es.nms.iou)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('es.nms.iou', ))
