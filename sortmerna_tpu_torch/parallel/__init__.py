"""Multi-device and multi-host execution on torch devices and
torch.distributed (the JAX package's parallel/ on a mesh).

* mesh.py: the device list that stands for the mesh, the sharded SW
  scoring step, and the host-side read partition;
* dist.py: the SW backend whose wave blocks are split over devices, read
  shards aligned in threads with their counters summed, and multi-host
  runs (one process a host, counters and barriers on gloo, report
  sections merged by process 0).
"""
