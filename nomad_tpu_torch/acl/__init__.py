"""ACL subsystem (reference `acl/` + `nomad/acl.go` + `nomad/structs`
ACL types): HCL policy documents compiled into capability matchers,
tokens resolved against stored policies, endpoint enforcement."""
from .acl import ACL, ACLError, management_acl
from .policy import (CAPABILITIES, NAMESPACE_CAPABILITIES, Policy,
                     parse_policy)
from .tokens import ACLPolicy, ACLToken, TokenStore, new_management_token

__all__ = ["ACL", "ACLError", "ACLPolicy", "ACLToken", "CAPABILITIES",
           "NAMESPACE_CAPABILITIES", "Policy", "TokenStore",
           "management_acl", "new_management_token", "parse_policy"]
