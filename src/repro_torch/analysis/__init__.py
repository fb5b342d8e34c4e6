"""Cost analysis of the port's step functions: analytic FLOPs and bytes
(``flops``), the three-term roofline on an H100 (``roofline``) and the dry
run's tables (``report``)."""
