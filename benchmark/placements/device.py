"""device: the frames as float32 tensors already on the card, as a solver
in the same process hands them to the library: no upload."""


def place(dev_frames: list, device):
    """(what the window hands the program, frame k's positions on the
    device, the bytes the frames hold on the device)."""
    frames = list(dev_frames)
    held = sum(f.numel() * f.element_size() for f in frames)
    return frames, (lambda k: frames[k]), held
