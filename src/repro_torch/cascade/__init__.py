"""CompactPlan cascade execution and the device table builder."""
