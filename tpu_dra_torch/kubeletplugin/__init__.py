"""DRA kubelet-plugin front-end (counterpart of tpu_dra.kubeletplugin):
the DRA v1 and registration services on gRPC and the framed socket, the
pipelined admission, and a hand-written proto3 codec for their messages."""
