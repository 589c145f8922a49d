"""The distributed layer of the port: one process per device, joined by a
torch.distributed process group (NCCL on CUDA, gloo on the CPU)."""
