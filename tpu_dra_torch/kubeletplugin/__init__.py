"""DRA kubelet-plugin types (counterpart of tpu_dra.kubeletplugin): the
prepare results handed back to kubelet."""
