"""The beacon API of the port: for now only `encoding` (API JSON <-> SSZ
values), which the builder's JSON codecs need.  The server, the client
and the routes (the JAX package's `lodestar_tpu/api/`) are not ported
yet: ROADMAP Queue A item 7.3."""

from .encoding import from_json, to_json  # noqa: F401
