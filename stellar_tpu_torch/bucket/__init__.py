"""State plane of the port: the bucket-hash pipeline (``hashplane``)."""
