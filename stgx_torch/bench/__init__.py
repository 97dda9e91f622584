"""On-device measurements of the port: streaming latency and the B-stream
serving cell. They need a CUDA device and raise without one."""
