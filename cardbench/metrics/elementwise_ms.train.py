"""Device ms a traced training step in the elementwise, copy/cast and
reduce kernel categories (``cbench.trace.CATEGORIES``)."""
from cbench.readers import elementwise_ms as read  # noqa: F401
