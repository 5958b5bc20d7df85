"""GPU kubelet plugin (counterpart of tpu_dra.tpuplugin): the device model,
CRC-framed checkpoint journal, time-slicing, the node's DeviceState, which
prepares and unprepares allocated ResourceClaims, and the driver, health
monitor and entry point that serve it to kubelet."""
