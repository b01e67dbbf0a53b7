"""Networks, weights and the closure-CNN kernel. Importing builds nothing."""
