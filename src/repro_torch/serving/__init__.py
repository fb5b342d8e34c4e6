"""Serving planes on the host fabric: pub/sub with its orderings
(``pubsub``), the sharded key-value router (``router``) and the region
gateway that terminates the fast path and the WAN link (``gateway``)."""
