"""ms of the program's loss block (`video_knet_loss` with its Hungarian
solve, and its backward) at fixed model outputs: isolated synchronised
calls after the window."""

def read(rec):
    return rec.get("loss_block_ms")
