"""The port's network layer: the wire format, a standard-library RPC, and
the datanode, SCM and OM services with their remote clients and daemons.

Port of `ozone_tpu/net/` (wire, rpc, dn_service, scm_service, om_service,
daemons). The reference rides gRPC; this package uses only `socket`,
`threading` and `struct`, with the reference's frames, method names and
error codes.
"""
