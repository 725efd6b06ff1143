"""host: the frames as float32 numpy arrays in host memory, as the CLI,
pysplashsurf and Blender hand them to the library; every call pays the
upload."""

import torch


def place(dev_frames: list, device):
    """(what the window hands the program, frame k's positions on the
    device, the bytes the frames hold on the device)."""
    frames = [f.cpu().numpy() for f in dev_frames]
    return frames, (lambda k: torch.as_tensor(frames[k]).to(device)), 0
