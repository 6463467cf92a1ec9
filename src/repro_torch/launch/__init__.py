"""Launch helpers of the port: the device mesh (:mod:`.mesh`)."""
