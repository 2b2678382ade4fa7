"""The LUBM university ontology at the RDFS level, frozen for the benchmark.

A copy of the program's ``rdf/vocab.py`` lists (43 concepts, 32 properties,
38 subClassOf, 5 subPropertyOf, 21 domain and 18 range axioms), so that a
change to the program cannot move the ontology the benchmark's data and its
reference are made from.  ``domain(headOf) = Chair`` is the RDFS reading of
LUBM's Chair restriction: the raw data has no explicit Chair triple, and the
Chair types are derived from ``headOf``.
"""
from __future__ import annotations

RDF_TYPE = "rdf:type"

CONCEPTS = [
    "University", "College", "Department", "Institute", "Program",
    "ResearchGroup", "Organization",
    "Work", "Course", "GraduateCourse", "Research", "Publication", "Article",
    "Book", "ConferencePaper", "JournalArticle", "Manual", "Software",
    "Specification", "TechnicalReport", "UnofficialPublication",
    "Person", "Employee", "AdministrativeStaff", "ClericalStaff",
    "SystemsStaff", "Faculty", "Lecturer", "PostDoc", "Professor",
    "AssistantProfessor", "AssociateProfessor", "Chair", "Dean",
    "FullProfessor", "VisitingProfessor", "Director", "Student",
    "GraduateStudent", "UndergraduateStudent", "ResearchAssistant",
    "TeachingAssistant",
    "Schedule",
]

SUBCLASS = [
    ("University", "Organization"), ("College", "Organization"),
    ("Department", "Organization"), ("Institute", "Organization"),
    ("Program", "Organization"), ("ResearchGroup", "Organization"),
    ("Course", "Work"), ("GraduateCourse", "Course"), ("Research", "Work"),
    ("Article", "Publication"), ("Book", "Publication"),
    ("ConferencePaper", "Article"), ("JournalArticle", "Article"),
    ("TechnicalReport", "Article"), ("Manual", "Publication"),
    ("Software", "Publication"), ("Specification", "Publication"),
    ("UnofficialPublication", "Publication"),
    ("Employee", "Person"), ("AdministrativeStaff", "Employee"),
    ("ClericalStaff", "AdministrativeStaff"),
    ("SystemsStaff", "AdministrativeStaff"), ("Faculty", "Employee"),
    ("Lecturer", "Faculty"), ("PostDoc", "Faculty"),
    ("Professor", "Faculty"), ("AssistantProfessor", "Professor"),
    ("AssociateProfessor", "Professor"), ("Chair", "Professor"),
    ("Dean", "Professor"), ("FullProfessor", "Professor"),
    ("VisitingProfessor", "Professor"), ("Director", "Person"),
    ("Student", "Person"), ("GraduateStudent", "Student"),
    ("UndergraduateStudent", "Student"), ("ResearchAssistant", "Person"),
    ("TeachingAssistant", "Person"),
]

OBJECT_PROPERTIES = [
    "advisor", "affiliatedOrganizationOf", "affiliateOf", "degreeFrom",
    "doctoralDegreeFrom", "mastersDegreeFrom", "undergraduateDegreeFrom",
    "headOf", "worksFor", "memberOf", "member", "orgPublication",
    "publicationAuthor", "publicationResearch", "researchProject",
    "softwareDocumentation", "subOrganizationOf", "takesCourse",
    "teacherOf", "teachingAssistantOf", "hasAlumnus", "listedCourse",
    "publicationDate", "softwareVersion", "tenured",
]
DATATYPE_PROPERTIES = [
    "age", "emailAddress", "name", "officeNumber", "researchInterest",
    "telephone", "title",
]
PROPERTIES = OBJECT_PROPERTIES + DATATYPE_PROPERTIES

SUBPROP = [
    ("doctoralDegreeFrom", "degreeFrom"),
    ("mastersDegreeFrom", "degreeFrom"),
    ("undergraduateDegreeFrom", "degreeFrom"),
    ("headOf", "worksFor"),
    ("worksFor", "memberOf"),
]

DOMAIN = {
    "advisor": ["Person"],
    "degreeFrom": ["Person"],
    "doctoralDegreeFrom": ["Person"],
    "mastersDegreeFrom": ["Person"],
    "undergraduateDegreeFrom": ["Person"],
    "headOf": ["Chair"],
    "worksFor": ["Employee"],
    "memberOf": ["Person"],
    "member": ["Organization"],
    "orgPublication": ["Organization"],
    "publicationAuthor": ["Publication"],
    "publicationResearch": ["Publication"],
    "researchProject": ["ResearchGroup"],
    "softwareDocumentation": ["Software"],
    "subOrganizationOf": ["Organization"],
    "takesCourse": ["Student"],
    "teacherOf": ["Faculty"],
    "teachingAssistantOf": ["TeachingAssistant"],
    "hasAlumnus": ["University"],
    "tenured": ["Professor"],
    "emailAddress": ["Person"],
}

RANGE = {
    "advisor": ["Professor"],
    "degreeFrom": ["University"],
    "doctoralDegreeFrom": ["University"],
    "mastersDegreeFrom": ["University"],
    "undergraduateDegreeFrom": ["University"],
    "headOf": ["Department"],
    "worksFor": ["Organization"],
    "memberOf": ["Organization"],
    "member": ["Person"],
    "orgPublication": ["Publication"],
    "publicationAuthor": ["Person"],
    "publicationResearch": ["Research"],
    "researchProject": ["Research"],
    "softwareDocumentation": ["Publication"],
    "subOrganizationOf": ["Organization"],
    "takesCourse": ["Course"],
    "teacherOf": ["Course"],
    "teachingAssistantOf": ["Course"],
}
