"""The benchmark's own tests run on the CPU at tiny sizes, one torch thread
a process: several test workers share the host's cores."""
import torch

torch.set_num_threads(1)
