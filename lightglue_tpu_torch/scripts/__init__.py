"""Studies and measurements that run the port on a CUDA device."""
