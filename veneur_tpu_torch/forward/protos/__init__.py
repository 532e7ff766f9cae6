"""Generated protobuf modules of the forward plane: byte copies of
veneur_tpu/forward/protos/*_pb2.py whose only change is the import line
of their dependencies. The serialized descriptors are identical, so both
packages can load them into one process's default descriptor pool."""
