"""Launch helpers of the port: the device mesh (:mod:`.mesh`) and the
continuous-batching LM server (:mod:`.serve`)."""
