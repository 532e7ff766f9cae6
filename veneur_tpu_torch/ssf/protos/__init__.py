"""The generated SSF protobuf module: a byte copy of
veneur_tpu/ssf/protos/ssf_pb2.py. The serialized descriptor is identical,
so both packages can load it into one process's default descriptor pool;
never regenerate it on its own."""
