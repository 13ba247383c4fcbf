"""Host-side launch helpers of the port (``SlotGrid``, ``ContinuousBatcher``)."""
