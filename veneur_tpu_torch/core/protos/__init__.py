"""The generated DogStatsD-over-gRPC protobuf module: a byte copy of
veneur_tpu/core/protos/dogstatsd_pb2.py. The serialized descriptor is
identical, so both packages can load it into one process's default
descriptor pool; never regenerate it on its own."""
