"""Device ms of the occupancy U-Net's forward (ImVoxelNeck span)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('unet', ))
