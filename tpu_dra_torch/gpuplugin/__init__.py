"""GPU kubelet plugin (counterpart of tpu_dra.tpuplugin): the device model,
CRC-framed checkpoint journal, time-slicing and the node's DeviceState,
which prepares and unprepares allocated ResourceClaims."""
