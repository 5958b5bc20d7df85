"""ComputeDomain kubelet plugin (counterpart of tpu_dra.cdplugin).

Node-side half of the ComputeDomain machinery: advertises synthetic
``channel`` + ``daemon`` devices, and on claim prepare performs the
readiness dance — label the node (pulling a domain-daemon pod here),
wait for the CD to report this node Ready, then inject the domain's
rendezvous env (worker id, peer hostnames, the torch.distributed
coordinator ``MASTER_ADDR``/``MASTER_PORT`` and this node's rank) into
the workload container via CDI.
"""
